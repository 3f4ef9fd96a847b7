"""Beacon-API HTTP server + typed client (stdlib only).

Twin of beacon_node/http_api (warp server, src/lib.rs:319 `serve`; 18,827
LoC there — the subset here covers the endpoints the implemented layers
serve) + common/eth2 (the typed client, src/lib.rs:1-5) + http_metrics (the
Prometheus scrape endpoint, mounted at /metrics).

JSON mapping follows the beacon-APIs conventions: uints as decimal strings,
roots/signatures as 0x-hex, containers as objects keyed by field name.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..consensus.ssz import (
    BOOLEAN,
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Container,
    SSZList,
    UintN,
    Vector,
    _ContainerField,
)
from ..utils import render as render_metrics

VERSION = "lighthouse-tpu/0.3.0"


# ---------------------------------------------------------------------------
# container <-> Beacon-API JSON
# ---------------------------------------------------------------------------


def to_json(type_or_cls, value):
    if isinstance(type_or_cls, type) and issubclass(type_or_cls, Container):
        return {
            f: to_json(t, getattr(value, f))
            for f, t in type_or_cls._fields.items()
        }
    if isinstance(type_or_cls, _ContainerField):
        return to_json(type_or_cls.cls, value)
    if isinstance(type_or_cls, UintN):
        return str(int(value))
    if isinstance(type_or_cls, type(BOOLEAN)):
        return bool(value)
    if isinstance(type_or_cls, (ByteVector, ByteList)):
        return "0x" + bytes(value).hex()
    if isinstance(type_or_cls, (Bitvector, Bitlist)):
        return "0x" + type_or_cls.serialize(value).hex()
    if isinstance(type_or_cls, (Vector, SSZList)):
        return [to_json(type_or_cls.elem, v) for v in value]
    raise TypeError(f"unmapped type {type_or_cls!r}")


def from_json(type_or_cls, data):
    if isinstance(type_or_cls, type) and issubclass(type_or_cls, Container):
        return type_or_cls(
            **{
                f: from_json(t, data[f])
                for f, t in type_or_cls._fields.items()
            }
        )
    if isinstance(type_or_cls, _ContainerField):
        return from_json(type_or_cls.cls, data)
    if isinstance(type_or_cls, UintN):
        return int(data)
    if isinstance(type_or_cls, type(BOOLEAN)):
        return bool(data)
    if isinstance(type_or_cls, (ByteVector, ByteList)):
        return bytes.fromhex(data[2:])
    if isinstance(type_or_cls, (Bitvector, Bitlist)):
        return type_or_cls.deserialize(bytes.fromhex(data[2:]))
    if isinstance(type_or_cls, (Vector, SSZList)):
        return [from_json(type_or_cls.elem, v) for v in data]
    raise TypeError(f"unmapped type {type_or_cls!r}")


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class BeaconApiServer:
    """Routes Beacon-API requests onto a BeaconChain (+ optional VC duties
    helpers).  `task_spawner.rs` in the reference pushes blocking work onto
    beacon_processor queues; here handlers run on the HTTP thread pool and
    heavy verification still flows through the chain's normal pipelines."""

    def __init__(self, chain, host: str = "127.0.0.1", port: int = 0,
                 node=None):
        self.chain = chain
        # optional BeaconNode back-reference: enables node/peers endpoints
        self.node = node
        # per-route hit counts (http_metrics analog; also lets the soak
        # tests assert the remote VC never touches the debug endpoints).
        # Numeric path segments (slots/epochs/ids) normalize to {n} so a
        # long soak doesn't grow one key per slot; the lock is for
        # ThreadingHTTPServer's concurrent handlers.
        self.request_counts: dict[str, int] = {}
        self._count_lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, payload, raw: bytes | None = None,
                      content_type: str = "application/json"):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.end_headers()
                if raw is not None:
                    self.wfile.write(raw)
                else:
                    self.wfile.write(json.dumps(payload).encode())

            def do_GET(self):
                try:
                    outer._get(self)
                except KeyError as e:
                    self._send(404, {"code": 404, "message": str(e)})
                except ValueError as e:  # malformed query/params = client error
                    self._send(400, {"code": 400, "message": str(e)})
                except Exception as e:  # noqa: BLE001
                    self._send(500, {"code": 500, "message": repr(e)})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                try:
                    outer._post(self, body)
                except ValueError as e:
                    self._send(400, {"code": 400, "message": str(e)})
                except Exception as e:  # noqa: BLE001
                    self._send(500, {"code": 500, "message": repr(e)})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    # ----------------------------------------------------------- routing

    def _count(self, path: str) -> None:
        route = "/".join(
            "{n}" if seg.isdigit() or seg.startswith("0x") else seg
            for seg in path.split("/")
        )
        with self._count_lock:
            self.request_counts[route] = self.request_counts.get(route, 0) + 1

    def _get(self, h) -> None:
        path = h.path.split("?")[0].rstrip("/")
        self._count(path)
        chain = self.chain
        if path == "/eth/v1/node/health":
            h._send(200, {})
            return
        if path == "/eth/v1/node/version":
            h._send(200, {"data": {"version": VERSION}})
            return
        if path == "/eth/v1/node/syncing":
            head = chain.head_state()
            cur = (
                chain.slot_clock.current_slot()
                if chain.slot_clock
                else int(head.slot)
            )
            distance = max(0, cur - int(head.slot))
            h._send(
                200,
                {
                    "data": {
                        "head_slot": str(int(head.slot)),
                        "sync_distance": str(distance),
                        "is_syncing": distance > 1,
                        "is_optimistic": False,
                        "el_offline": True,
                    }
                },
            )
            return
        if path == "/eth/v1/beacon/genesis":
            st = chain.head_state()
            h._send(
                200,
                {
                    "data": {
                        "genesis_time": str(int(st.genesis_time)),
                        "genesis_validators_root": "0x"
                        + bytes(st.genesis_validators_root).hex(),
                        "genesis_fork_version": "0x"
                        + bytes(chain.spec.genesis_fork_version).hex(),
                    }
                },
            )
            return
        if path.startswith("/eth/v1/beacon/states/") and path.endswith("/root"):
            state = self._resolve_state(path.split("/")[5])
            h._send(200, {"data": {"root": "0x" + state.root().hex()}})
            return
        if path.startswith("/eth/v1/beacon/states/") and path.endswith(
            "/finality_checkpoints"
        ):
            state = self._resolve_state(path.split("/")[5])

            def cp(c):
                return {"epoch": str(int(c.epoch)), "root": "0x" + bytes(c.root).hex()}

            h._send(
                200,
                {
                    "data": {
                        "previous_justified": cp(state.previous_justified_checkpoint),
                        "current_justified": cp(state.current_justified_checkpoint),
                        "finalized": cp(state.finalized_checkpoint),
                    }
                },
            )
            return
        if path.startswith("/eth/v1/beacon/states/") and path.endswith(
            "/validators"
        ):
            state = self._resolve_state(path.split("/")[5])
            current = int(state.slot) // chain.preset.slots_per_epoch
            out = []
            for i, v in enumerate(state.validators):
                active = v.activation_epoch <= current < v.exit_epoch
                if v.slashed:
                    status = "active_slashed" if active else "exited_slashed"
                elif active:
                    status = "active_ongoing"
                elif v.activation_epoch > current:
                    status = "pending_queued"
                else:
                    status = "exited_unslashed"
                out.append(
                    {
                        "index": str(i),
                        "balance": str(int(state.balances[i])),
                        "status": status,
                        "validator": {
                            "pubkey": "0x" + bytes(v.pubkey).hex(),
                            "effective_balance": str(int(v.effective_balance)),
                            "slashed": bool(v.slashed),
                            "activation_epoch": str(int(v.activation_epoch)),
                            "exit_epoch": str(int(v.exit_epoch)),
                        },
                    }
                )
            h._send(200, {"data": out})
            return
        if path.startswith("/eth/v1/beacon/headers"):
            root = self._resolve_block_root(path.split("/")[-1])
            if root == chain.genesis_block_root:
                # the anchor is a header, not a stored SignedBeaconBlock
                state = chain.state_for_block(root)
                hdr = state.latest_block_header.copy()
                if bytes(hdr.state_root) == bytes(32):
                    hdr.state_root = state.root()
                h._send(
                    200,
                    {
                        "data": {
                            "root": "0x" + root.hex(),
                            "canonical": True,
                            "header": {
                                "message": {
                                    "slot": str(int(hdr.slot)),
                                    "proposer_index": str(
                                        int(hdr.proposer_index)
                                    ),
                                    "parent_root": "0x"
                                    + bytes(hdr.parent_root).hex(),
                                    "state_root": "0x"
                                    + bytes(hdr.state_root).hex(),
                                    "body_root": "0x"
                                    + bytes(hdr.body_root).hex(),
                                },
                                "signature": "0x" + "00" * 96,
                            },
                        }
                    },
                )
                return
            blk = chain.store.get_block(
                root, chain.types.SignedBeaconBlock_BY_FORK[chain.fork_name]
            )
            if blk is None:
                raise KeyError("block not found")
            msg = blk.message
            h._send(
                200,
                {
                    "data": {
                        "root": "0x" + root.hex(),
                        "canonical": True,
                        "header": {
                            "message": {
                                "slot": str(int(msg.slot)),
                                "proposer_index": str(int(msg.proposer_index)),
                                "parent_root": "0x" + bytes(msg.parent_root).hex(),
                                "state_root": "0x" + bytes(msg.state_root).hex(),
                                "body_root": "0x"
                                + type(msg)._fields["body"].hash_tree_root(msg.body).hex(),
                            },
                            "signature": "0x" + bytes(blk.signature).hex(),
                        },
                    }
                },
            )
            return
        if path.startswith("/eth/v2/beacon/blocks/"):
            root = self._resolve_block_root(path.split("/")[-1])
            blk = chain.store.get_block(
                root, chain.types.SignedBeaconBlock_BY_FORK[chain.fork_name]
            )
            if blk is None:
                raise KeyError("block not found")
            h._send(
                200,
                {
                    "version": chain.fork_name,
                    "data": to_json(type(blk), blk),
                },
            )
            return
        if path.startswith("/eth/v1/validator/duties/proposer/"):
            epoch = int(path.split("/")[-1])
            from ..consensus import committees as cm

            state = chain.head_state()
            duties = []
            preset = chain.preset
            for slot in range(
                max(epoch * preset.slots_per_epoch, int(state.slot), 1),
                (epoch + 1) * preset.slots_per_epoch,
            ):
                vi = cm.get_beacon_proposer_index(state, slot, preset)
                duties.append(
                    {
                        "pubkey": "0x" + bytes(state.validators[vi].pubkey).hex(),
                        "validator_index": str(vi),
                        "slot": str(slot),
                    }
                )
            h._send(
                200,
                {
                    "data": duties,
                    "dependent_root": "0x"
                    + self._dependent_root(state, epoch, attester=False).hex(),
                },
            )
            return
        if path.startswith("/eth/v1/validator/duties/attester/"):
            # GET variant (the reference serves POST with index filters;
            # the GET form returns all indices' duties for the epoch)
            from ..consensus import committees as cm

            epoch = int(path.split("/")[-1])
            state = chain.head_state()
            cache = chain.committee_cache(state, epoch)
            duties = []
            for slot, index, committee in cm.iter_epoch_committees(
                cache, epoch, chain.preset
            ):
                for pos, vi in enumerate(committee):
                    duties.append(
                        {
                            "pubkey": "0x"
                            + bytes(state.validators[int(vi)].pubkey).hex(),
                            "validator_index": str(int(vi)),
                            "committee_index": str(index),
                            "committee_length": str(len(committee)),
                            "validator_committee_index": str(pos),
                            "slot": str(slot),
                        }
                    )
            h._send(
                200,
                {
                    "data": duties,
                    "dependent_root": "0x"
                    + self._dependent_root(state, epoch, attester=True).hex(),
                },
            )
            return
        if path.startswith("/eth/v3/validator/blocks/"):
            # produce_block.rs over the wire: the VC supplies only the
            # randao reveal; the BN advances the head state, max-cover
            # packs the op pool, and returns the UNSIGNED block (v3 says
            # blinded-or-full; we always serve full + a zero consensus
            # value — no local bid comparison data at this endpoint).
            from urllib.parse import parse_qs, urlparse

            q = parse_qs(urlparse(h.path).query)
            slot = int(path.split("/")[-1])
            reveal = q.get("randao_reveal", [None])[0]
            if reveal is None:
                raise ValueError("randao_reveal is required")
            graffiti = bytes.fromhex(
                q.get("graffiti", ["0x"])[0].removeprefix("0x")
            )
            block, fork_now = chain.produce_unsigned_block(
                slot, bytes.fromhex(reveal.removeprefix("0x")), graffiti
            )
            h._send(
                200,
                {
                    "version": fork_now,
                    "execution_payload_blinded": False,
                    "execution_payload_value": "0",
                    "consensus_block_value": "0",
                    "data": to_json(type(block), block),
                },
            )
            return
        if path == "/eth/v1/validator/attestation_data":
            # the BN-side attestation template (the VC no longer needs
            # the state: validator/attestation_data in http_api/src/
            # lib.rs) — the chain owns the single shared derivation
            from urllib.parse import parse_qs, urlparse

            from ..consensus.containers import AttestationData

            q = parse_qs(urlparse(h.path).query)
            if "slot" not in q or "committee_index" not in q:
                raise ValueError("slot and committee_index are required")
            data = chain.attestation_data_for(
                int(q["slot"][0]), int(q["committee_index"][0])
            )
            h._send(200, {"data": to_json(AttestationData, data)})
            return
        if path == "/eth/v1/validator/aggregate_attestation":
            from urllib.parse import parse_qs, urlparse

            from ..consensus.containers import Attestation

            q = parse_qs(urlparse(h.path).query)
            if "attestation_data_root" not in q:
                raise ValueError("attestation_data_root is required")
            root = bytes.fromhex(
                q["attestation_data_root"][0].removeprefix("0x")
            )
            agg = chain.naive_pool.get_aggregate(root)
            if agg is None:
                raise KeyError("no aggregate known for that data root")
            h._send(200, {"data": to_json(Attestation, agg)})
            return
        if path == "/eth/v1/config/spec":
            import dataclasses

            spec = chain.spec
            flat = {}
            for f in dataclasses.fields(spec):
                v = getattr(spec, f.name)
                if isinstance(v, bytes):
                    flat[f.name.upper()] = "0x" + v.hex()
                elif isinstance(v, int):
                    flat[f.name.upper()] = str(v)
            for f in dataclasses.fields(spec.preset):
                v = getattr(spec.preset, f.name)
                if isinstance(v, int):
                    flat[f.name.upper()] = str(v)
            h._send(200, {"data": flat})
            return
        if path.startswith("/eth/v2/debug/beacon/states/"):
            state = self._resolve_state(path.split("/")[-1])
            h._send(200, None, raw=state.encode(),
                    content_type="application/octet-stream")
            return
        if path == "/metrics":
            h._send(200, None, raw=render_metrics().encode(),
                    content_type="text/plain; version=0.0.4")
            return
        if path == "/eth/v1/events":
            self._serve_sse(h)
            return
        if path == "/eth/v1/node/identity":
            node = self.node
            peer_id = (
                "0x" + node.host.peer_id.hex() if node is not None else "0x"
            )
            enr = ""
            if node is not None and node.discovery is not None:
                enr = node.discovery.enr.to_text()
            h._send(200, {"data": {
                "peer_id": peer_id,
                "enr": enr,
                "p2p_addresses": [],
                "discovery_addresses": [],
                "metadata": {"seq_number": "1", "attnets": "0x" + "00" * 8},
            }})
            return
        if path == "/eth/v1/node/peers":
            h._send(200, {"data": self._peers_json(),
                          "meta": {"count": len(self._peers_json())}})
            return
        if path == "/eth/v1/node/peer_count":
            peers = self._peers_json()
            connected = sum(1 for p in peers if p["state"] == "connected")
            h._send(200, {"data": {
                "disconnected": str(len(peers) - connected),
                "connecting": "0",
                "connected": str(connected),
                "disconnecting": "0",
            }})
            return
        if path == "/eth/v1/beacon/pool/voluntary_exits":
            from ..consensus.containers import SignedVoluntaryExit

            h._send(200, {"data": [
                to_json(SignedVoluntaryExit, e)
                for e in chain.op_pool.voluntary_exits.values()
            ]})
            return
        if path == "/eth/v1/beacon/pool/attester_slashings":
            from ..consensus.containers import AttesterSlashing

            h._send(200, {"data": [
                to_json(AttesterSlashing, s)
                for s in chain.op_pool.attester_slashings
            ]})
            return
        if path == "/eth/v1/beacon/pool/proposer_slashings":
            from ..consensus.containers import ProposerSlashing

            h._send(200, {"data": [
                to_json(ProposerSlashing, s)
                for s in chain.op_pool.proposer_slashings.values()
            ]})
            return
        if path.startswith("/eth/v1/beacon/blob_sidecars/"):
            root = self._resolve_block_root(path.split("/")[-1])
            sidecars = chain.store.get_blobs(
                root, chain.preset.max_blobs_per_block
            )
            h._send(200, {"data": [
                to_json(type(sc), sc) for sc in sidecars
            ]})
            return
        if path.startswith("/eth/v1/beacon/rewards/blocks/"):
            root = self._resolve_block_root(path.split("/")[-1])
            blk = chain.store.get_block(
                root, self._block_cls_for_root(root)
            )
            post = chain.state_for_block(root)
            if blk is None or post is None:
                raise KeyError("block/state not held")
            parent = chain.state_for_block(bytes(blk.message.parent_root))
            proposer = int(blk.message.proposer_index)
            # total = proposer balance delta across the block (covers
            # attestation-inclusion + sync-aggregate + slashing rewards;
            # the reference splits components — this reports the sum in
            # `total` with attestations as the dominant attribution)
            total = 0
            if parent is not None and proposer < len(parent.balances):
                total = int(post.balances[proposer]) - int(
                    parent.balances[proposer]
                )
            h._send(200, {"execution_optimistic": False, "finalized": False,
                          "data": {
                              "proposer_index": str(proposer),
                              "total": str(total),
                              "attestations": str(total),
                              "sync_aggregate": "0",
                              "proposer_slashings": "0",
                              "attester_slashings": "0",
                          }})
            return
        if path.startswith("/eth/v1/beacon/light_client/bootstrap/"):
            from ..consensus.light_client import build_bootstrap

            root = self._resolve_block_root(path.split("/")[-1])
            state = chain.state_for_block(root)
            blk = chain.store.get_block(root, self._block_cls_for_root(root))
            if state is None or blk is None:
                raise KeyError("bootstrap state not held")
            from ..consensus.containers import BeaconBlockHeader

            msg = blk.message
            header = BeaconBlockHeader(
                slot=int(msg.slot),
                proposer_index=int(msg.proposer_index),
                parent_root=bytes(msg.parent_root),
                state_root=bytes(msg.state_root),
                body_root=type(msg)._fields["body"].hash_tree_root(msg.body),
            )
            bootstrap = build_bootstrap(state, header, chain.types)
            h._send(200, {"version": chain.fork_name,
                          "data": to_json(type(bootstrap), bootstrap)})
            return
        raise KeyError(f"no route {path}")

    def _block_cls_for_root(self, root: bytes):
        """Decode a STORED block with the fork class of its own slot (not
        the chain's active fork) — a node that crossed a fork boundary
        must still decode pre-fork history (round-3 weak item 5)."""
        chain = self.chain
        blk_state = chain.state_for_block(root)
        if blk_state is not None:
            from ..consensus.state_processing.forks import state_fork_name

            return chain.types.SignedBeaconBlock_BY_FORK[
                state_fork_name(blk_state)
            ]
        return chain.types.SignedBeaconBlock_BY_FORK[chain.fork_name]

    def _peers_json(self) -> list:
        node = self.node
        if node is None:
            return []
        out = []
        pm = node.host.peer_manager
        connected = {pid.hex() for pid in node.host.connections}
        for pid_hex, rec in pm.peers.items():
            state = "connected" if pid_hex in connected else "disconnected"
            out.append({
                "peer_id": "0x" + pid_hex,
                "state": state,
                "direction": "outbound",
                "score": round(rec.score(), 3),
                "banned": rec.banned,
            })
        return out

    def _serve_sse(self, h) -> None:
        """`/eth/v1/events?topics=head,block,...` — the SSE stream
        (events.rs), one `event:`/`data:` pair per chain milestone."""
        from urllib.parse import parse_qs, urlparse

        q = parse_qs(urlparse(h.path).query)
        topics = set(
            t for raw in q.get("topics", []) for t in raw.split(",")
        ) or None
        sub = self.chain.events.subscribe()
        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-cache")
        h.end_headers()
        import queue as _q

        try:
            while True:
                try:
                    kind, data = sub.get(timeout=1.0)
                except _q.Empty:
                    h.wfile.write(b": keepalive\n\n")  # comment ping
                    h.wfile.flush()
                    continue
                if topics is not None and kind not in topics:
                    continue
                payload = (
                    f"event: {kind}\ndata: {json.dumps(data)}\n\n".encode()
                )
                h.wfile.write(payload)
                h.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # client went away
        finally:
            self.chain.events.unsubscribe(sub)

    def _post(self, h, body: bytes) -> None:
        path = h.path.rstrip("/")
        self._count(path)
        chain = self.chain
        if path in ("/eth/v1/beacon/blocks", "/eth/v2/beacon/blocks"):
            ctype = h.headers.get("Content-Type", "application/json")
            cls = chain.types.SignedBeaconBlock_BY_FORK[chain.fork_name]
            if "octet-stream" in ctype:
                signed = cls.deserialize_value(body)
            else:
                signed = from_json(cls, json.loads(body))
            try:
                chain.process_block(signed)
            except Exception as e:
                raise ValueError(f"block rejected: {e}") from None
            h._send(200, {})
            return
        if path == "/eth/v1/beacon/pool/attestations":
            from ..consensus.containers import Attestation

            payload = json.loads(body)
            failures = []
            for i, item in enumerate(payload):
                att = from_json(Attestation, item)
                try:
                    # the pool endpoint receives UNAGGREGATED attestations
                    # from VCs (http_api/src/lib.rs attestation publish):
                    # single-bit ones ride the unaggregated ladder into
                    # the naive pool so the BN can serve them back via
                    # aggregate_attestation; merged ones take the
                    # aggregate pipeline
                    bits = [bool(b) for b in att.aggregation_bits]
                    if sum(bits) == 1:
                        chain.process_unaggregated_attestation(att)
                        if self.node is not None:
                            from ..network.topics import (
                                compute_subnet_for_attestation,
                            )

                            cache = chain.committee_cache(
                                chain.head_state(),
                                int(att.data.slot)
                                // chain.preset.slots_per_epoch,
                            )
                            subnet = compute_subnet_for_attestation(
                                chain.spec, int(att.data.slot),
                                int(att.data.index),
                                cache.committees_per_slot,
                            )
                            self.node.publish_attestation_single(subnet, att)
                    else:
                        chain.process_attestation(att)
                except Exception as e:  # collect per-index failures
                    failures.append({"index": i, "message": str(e)})
            if failures:
                h._send(400, {"code": 400, "message": "some attestations failed",
                              "failures": failures})
            else:
                h._send(200, {})
            return
        if path == "/eth/v1/beacon/pool/voluntary_exits":
            from ..consensus.containers import SignedVoluntaryExit
            from ..consensus.state_processing import signature_sets as sets_mod

            signed = from_json(SignedVoluntaryExit, json.loads(body))
            state = chain.head_state()
            s = sets_mod.exit_signature_set(
                state, chain.get_pubkey, signed, chain.spec
            )
            if not s.verify():
                raise ValueError("exit signature invalid")
            chain.op_pool.insert_voluntary_exit(signed)
            chain.events.emit("voluntary_exit", {
                "message": {
                    "epoch": str(int(signed.message.epoch)),
                    "validator_index": str(int(signed.message.validator_index)),
                },
            })
            h._send(200, {})
            return
        if path == "/eth/v1/beacon/pool/attester_slashings":
            from ..consensus.containers import AttesterSlashing

            slashing = from_json(AttesterSlashing, json.loads(body))
            chain.op_pool.insert_attester_slashing(slashing)
            h._send(200, {})
            return
        if path == "/eth/v1/beacon/pool/proposer_slashings":
            from ..consensus.containers import ProposerSlashing

            slashing = from_json(ProposerSlashing, json.loads(body))
            chain.op_pool.insert_proposer_slashing(slashing)
            h._send(200, {})
            return
        if path == "/eth/v1/beacon/pool/sync_committees":
            from ..beacon.sync_committee import subnets_for_validator

            payload = json.loads(body)
            state = chain.head_state()
            failures = []
            for i, item in enumerate(payload):
                msg = from_json(chain.types.SyncCommitteeMessage, item)
                subnets = subnets_for_validator(
                    state, int(msg.validator_index), chain.spec
                )
                try:
                    if not subnets:
                        raise ValueError("not in the sync committee")
                    chain.process_sync_committee_message(
                        msg, next(iter(subnets))
                    )
                except Exception as e:  # noqa: BLE001
                    failures.append({"index": i, "message": str(e)})
            if failures:
                h._send(400, {"code": 400, "message": "some messages failed",
                              "failures": failures})
            else:
                h._send(200, {})
            return
        if path == "/eth/v1/beacon/pool/bls_to_execution_changes":
            from ..consensus.containers import SignedBLSToExecutionChange
            from ..consensus.state_processing import signature_sets as sets_mod

            payload = json.loads(body)
            state = chain.head_state()
            for item in payload:
                signed = from_json(SignedBLSToExecutionChange, item)
                s = sets_mod.bls_execution_change_signature_set(
                    state, signed, chain.spec
                )
                if not s.verify():
                    raise ValueError("bls-to-execution-change signature invalid")
                chain.op_pool.bls_changes[
                    int(signed.message.validator_index)
                ] = signed
            h._send(200, {})
            return
        if path.startswith("/eth/v1/validator/liveness/"):
            # lighthouse's liveness endpoint (doppelganger_service.rs polls
            # it): a validator is live in an epoch if the chain saw any
            # participation flag for it in that epoch's participation list
            epoch = int(path.split("/")[-1])
            indices = [int(x) for x in json.loads(body)]
            state = chain.head_state()
            current = int(state.slot) // chain.preset.slots_per_epoch
            if epoch == current:
                participation = list(state.current_epoch_participation)
            elif epoch == current - 1:
                participation = list(state.previous_epoch_participation)
            else:
                participation = []
            out = []
            for i in indices:
                live = i < len(participation) and participation[i] != 0
                out.append({"index": str(i), "is_live": bool(live)})
            h._send(200, {"data": out})
            return
        if path.startswith("/eth/v1/validator/duties/attester/"):
            # POST variant — the reference's VC<->BN duties contract
            # (validator/duties/attester in http_api/src/lib.rs:319): the
            # VC sends its indices, the BN shuffles server-side.  This is
            # what lets the remote VC drop the O(state) debug fetch.
            from ..consensus import committees as cm

            epoch = int(path.split("/")[-1])
            want = {int(x) for x in json.loads(body)}
            state = chain.head_state()
            cache = chain.committee_cache(state, epoch)
            per_slot = cache.committees_per_slot
            duties = []
            for slot, index, committee in cm.iter_epoch_committees(
                cache, epoch, chain.preset
            ):
                for pos, vi in enumerate(committee):
                    if int(vi) not in want:
                        continue
                    duties.append(
                        {
                            "pubkey": "0x"
                            + bytes(state.validators[int(vi)].pubkey).hex(),
                            "validator_index": str(int(vi)),
                            "committee_index": str(index),
                            "committee_length": str(len(committee)),
                            "committees_at_slot": str(per_slot),
                            "validator_committee_index": str(pos),
                            "slot": str(slot),
                        }
                    )
            h._send(
                200,
                {
                    "data": duties,
                    "dependent_root": "0x"
                    + self._dependent_root(state, epoch, attester=True).hex(),
                    "execution_optimistic": False,
                },
            )
            return
        if path == "/eth/v1/validator/aggregate_and_proofs":
            # publish_aggregate_and_proofs (publish_blocks.rs sibling):
            # verify the envelope exactly like the gossip path (selection
            # proof + outer signature; the indexed attestation inside is
            # checked by process_attestation), import, then re-gossip.
            from ..consensus.containers import SignedAggregateAndProof
            from ..consensus.state_processing import signature_sets as sets_mod
            from ..crypto.bls import api as bls

            payload = json.loads(body)
            failures = []
            state = chain.head_state()
            for i, item in enumerate(payload):
                signed = from_json(SignedAggregateAndProof, item)
                try:
                    envelope = [
                        sets_mod.selection_proof_signature_set(
                            state, chain.get_pubkey,
                            int(signed.message.aggregator_index),
                            int(signed.message.aggregate.data.slot),
                            bytes(signed.message.selection_proof),
                            chain.preset,
                        ),
                        sets_mod.aggregate_and_proof_signature_set(
                            state, chain.get_pubkey, signed, chain.preset
                        ),
                    ]
                    if not bls.verify_signature_sets(envelope):
                        raise ValueError("aggregate envelope invalid")
                    chain.process_attestation(signed.message.aggregate)
                    if self.node is not None:
                        self.node.publish_aggregate(signed)
                except Exception as e:  # noqa: BLE001
                    failures.append({"index": i, "message": str(e)})
            if failures:
                h._send(400, {"code": 400,
                              "message": "some aggregates failed",
                              "failures": failures})
            else:
                h._send(200, {})
            return
        if path == "/eth/v1/validator/beacon_committee_subscriptions":
            # subscribe_to_subnets: route duty subscriptions into the
            # attestation-subnet service so the BN joins/aggregates on the
            # right subnets (validator/beacon_committee_subscriptions).
            payload = json.loads(body)
            if self.node is not None and payload:
                from ..validator.client import Duty

                # committees_at_slot feeds the subnet derivation and may
                # differ across items (epochs in one batch): group by it
                # rather than flattening to one global value
                by_count: dict[int, list] = {}
                for item in payload:
                    by_count.setdefault(
                        int(item["committees_at_slot"]), []
                    ).append(
                        Duty(
                            validator_index=int(item["validator_index"]),
                            slot=int(item["slot"]),
                            committee_index=int(item["committee_index"]),
                            committee_position=0,
                            committee_size=0,
                        )
                    )
                for per_slot, duties in by_count.items():
                    self.node.subscribe_committee_duties(duties, per_slot)
            h._send(200, {})
            return
        if path.startswith("/eth/v1/validator/duties/sync/"):
            from ..beacon.sync_committee import sync_committee_indices

            state = chain.head_state()
            want = {int(x) for x in json.loads(body)} if body else None
            indices = sync_committee_indices(state)
            duties = []
            for vi in sorted(set(indices)):
                if want is not None and vi not in want:
                    continue
                duties.append({
                    "pubkey": "0x" + bytes(state.validators[vi].pubkey).hex(),
                    "validator_index": str(vi),
                    "validator_sync_committee_indices": [
                        str(pos) for pos, holder in enumerate(indices)
                        if holder == vi
                    ],
                })
            h._send(200, {"data": duties, "execution_optimistic": False})
            return
        raise KeyError(f"no route {path}")

    # ----------------------------------------------------------- helpers

    def _dependent_root(self, state, epoch: int, attester: bool) -> bytes:
        """The shuffling-decision anchor duties depend on (duties_service
        .rs contract): the last block before epoch-1 (attester) / the
        epoch (proposer).  Stable across head changes WITHIN an epoch —
        a VC caching duties on it must not see churn every slot."""
        chain = self.chain
        spe = chain.preset.slots_per_epoch
        anchor = (epoch - (1 if attester else 0)) * spe - 1
        if anchor < 0 or int(state.slot) == 0:
            return chain.head_root
        if anchor >= int(state.slot):
            return chain.head_root
        if int(state.slot) - anchor > chain.preset.slots_per_historical_root:
            return chain.head_root
        return bytes(
            state.block_roots[anchor % chain.preset.slots_per_historical_root]
        )

    def _resolve_state(self, state_id: str):
        chain = self.chain
        if state_id == "head":
            return chain.head_state()
        if state_id in ("justified", "finalized"):
            cp = (
                chain.fork_choice.justified_checkpoint
                if state_id == "justified"
                else chain.fork_choice.finalized_checkpoint
            )
            st = chain.state_for_block(cp[1])
            if st is None:
                raise KeyError(f"{state_id} state not held")
            return st
        if state_id.startswith("0x"):
            # decode with the chain's ACTIVE fork class — the store's
            # default (base) would mis-deserialize post-altair states
            st = chain.store.get_state(
                bytes.fromhex(state_id[2:]),
                state_cls=chain.types.BeaconState_BY_FORK[chain.fork_name],
            )
            if st is None:
                raise KeyError("state not found")
            return st
        raise KeyError(f"unsupported state id {state_id}")

    def _resolve_block_root(self, block_id: str) -> bytes:
        if block_id == "head":
            return self.chain.head_root
        if block_id == "finalized":
            root = self.chain.fork_choice.finalized_checkpoint[1]
            if root == self.chain.genesis_block_root or root in self.chain._states:
                return root
            return root
        if block_id == "genesis":
            return self.chain.genesis_block_root
        if block_id.startswith("0x"):
            return bytes.fromhex(block_id[2:])
        if block_id.isdigit():
            # slot id: resolved through the head state's block_roots ring
            # (a skipped slot yields the last block at or before it, the
            # ring's semantics; consumers dedupe by root)
            slot = int(block_id)
            chain = self.chain
            state = chain.head_state()
            head_slot = int(state.slot)
            sphr = chain.preset.slots_per_historical_root
            if slot == head_slot:
                return chain.head_root
            if 0 <= slot < head_slot and head_slot - slot <= sphr:
                return bytes(state.block_roots[slot % sphr])
            raise KeyError(f"slot {block_id} outside the historical window")
        raise KeyError(f"unsupported block id {block_id}")

    # ----------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True, name="beacon-api"
        )
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class BeaconApiClient:
    """Typed client (common/eth2's BeaconNodeHttpClient shape)."""

    def __init__(self, base_url: str, timeout: float = 10.0):
        self.base = base_url.rstrip("/")
        self.timeout = timeout

    def _get(self, path: str) -> dict:
        with urllib.request.urlopen(self.base + path, timeout=self.timeout) as r:
            return json.loads(r.read())

    def _post(self, path: str, payload, ssz: bytes | None = None) -> dict:
        if ssz is not None:
            req = urllib.request.Request(
                self.base + path, data=ssz,
                headers={"Content-Type": "application/octet-stream"},
            )
        else:
            req = urllib.request.Request(
                self.base + path, data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
            )
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read() or b"{}")

    def node_version(self) -> str:
        return self._get("/eth/v1/node/version")["data"]["version"]

    def node_syncing(self) -> dict:
        return self._get("/eth/v1/node/syncing")["data"]

    def genesis(self) -> dict:
        return self._get("/eth/v1/beacon/genesis")["data"]

    def state_root(self, state_id: str = "head") -> bytes:
        d = self._get(f"/eth/v1/beacon/states/{state_id}/root")
        return bytes.fromhex(d["data"]["root"][2:])

    def finality_checkpoints(self, state_id: str = "head") -> dict:
        return self._get(
            f"/eth/v1/beacon/states/{state_id}/finality_checkpoints"
        )["data"]

    def block_header(self, block_id: str = "head") -> dict:
        return self._get(f"/eth/v1/beacon/headers/{block_id}")["data"]

    def get_block_json(self, block_id: str = "head") -> dict:
        return self._get(f"/eth/v2/beacon/blocks/{block_id}")

    def get_state_ssz(self, state_id: str = "finalized") -> bytes:
        with urllib.request.urlopen(
            self.base + f"/eth/v2/debug/beacon/states/{state_id}",
            timeout=self.timeout,
        ) as r:
            return r.read()

    def validators(self, state_id: str = "head") -> list[dict]:
        return self._get(f"/eth/v1/beacon/states/{state_id}/validators")["data"]

    def attester_duties(self, epoch: int) -> list[dict]:
        return self._get(f"/eth/v1/validator/duties/attester/{epoch}")["data"]

    def proposer_duties(self, epoch: int) -> list[dict]:
        return self._get(f"/eth/v1/validator/duties/proposer/{epoch}")["data"]

    def attester_duties_post(self, epoch: int, indices: list[int]) -> dict:
        """POST duties contract (the production VC<->BN path): returns the
        full response so callers can key caches on dependent_root."""
        return self._post(
            f"/eth/v1/validator/duties/attester/{epoch}",
            [str(i) for i in indices],
        )

    def attestation_data(self, slot: int, committee_index: int) -> dict:
        return self._get(
            f"/eth/v1/validator/attestation_data?slot={slot}"
            f"&committee_index={committee_index}"
        )["data"]

    def aggregate_attestation(self, slot: int, data_root: bytes) -> dict:
        return self._get(
            f"/eth/v1/validator/aggregate_attestation?slot={slot}"
            f"&attestation_data_root=0x{data_root.hex()}"
        )["data"]

    def publish_aggregate_and_proofs(self, signed_aggregates) -> None:
        self._post(
            "/eth/v1/validator/aggregate_and_proofs",
            [to_json(type(s), s) for s in signed_aggregates],
        )

    def subscribe_beacon_committees(self, subscriptions: list[dict]) -> None:
        self._post(
            "/eth/v1/validator/beacon_committee_subscriptions", subscriptions
        )

    def produce_block_v3(
        self, slot: int, randao_reveal: bytes, graffiti: bytes = b""
    ) -> dict:
        """Full v3 production response: {version, data: unsigned block}."""
        return self._get(
            f"/eth/v3/validator/blocks/{slot}"
            f"?randao_reveal=0x{randao_reveal.hex()}"
            f"&graffiti=0x{graffiti.hex()}"
        )

    def spec(self) -> dict:
        return self._get("/eth/v1/config/spec")["data"]

    def publish_block_ssz(self, signed_block) -> None:
        self._post("/eth/v1/beacon/blocks", None, ssz=signed_block.encode())

    def publish_attestations(self, attestations) -> None:
        from ..consensus.containers import Attestation

        self._post(
            "/eth/v1/beacon/pool/attestations",
            [to_json(Attestation, a) for a in attestations],
        )

    def metrics(self) -> str:
        with urllib.request.urlopen(
            self.base + "/metrics", timeout=self.timeout
        ) as r:
            return r.read().decode()

    # --- round-4 breadth --------------------------------------------------

    def node_peers(self) -> list[dict]:
        return self._get("/eth/v1/node/peers")["data"]

    def node_identity(self) -> dict:
        return self._get("/eth/v1/node/identity")["data"]

    def pool_voluntary_exits(self) -> list[dict]:
        return self._get("/eth/v1/beacon/pool/voluntary_exits")["data"]

    def submit_voluntary_exit(self, signed_exit) -> None:
        from ..consensus.containers import SignedVoluntaryExit

        self._post(
            "/eth/v1/beacon/pool/voluntary_exits",
            to_json(SignedVoluntaryExit, signed_exit),
        )

    def submit_sync_messages(self, messages, msg_cls) -> None:
        self._post(
            "/eth/v1/beacon/pool/sync_committees",
            [to_json(msg_cls, m) for m in messages],
        )

    def sync_duties(self, epoch: int, indices: list[int]) -> list[dict]:
        return self._post(
            f"/eth/v1/validator/duties/sync/{epoch}", [str(i) for i in indices]
        )["data"]

    def blob_sidecars(self, block_id: str = "head") -> list[dict]:
        return self._get(f"/eth/v1/beacon/blob_sidecars/{block_id}")["data"]

    def block_rewards(self, block_id: str = "head") -> dict:
        return self._get(f"/eth/v1/beacon/rewards/blocks/{block_id}")["data"]

    def light_client_bootstrap(self, block_root: bytes) -> dict:
        return self._get(
            f"/eth/v1/beacon/light_client/bootstrap/0x{block_root.hex()}"
        )

    def validator_liveness(self, epoch: int, indices: list[int]) -> list[dict]:
        return self._post(
            f"/eth/v1/validator/liveness/{epoch}", [str(i) for i in indices]
        )["data"]

    def stream_events(self, topics: list[str] | None = None,
                      timeout: float | None = None):
        """Generator over `/eth/v1/events` SSE: yields (event, data) —
        the VC's push-based head-following mode (events.rs consumer)."""
        q = "?topics=" + ",".join(topics) if topics else ""
        req = urllib.request.Request(self.base + "/eth/v1/events" + q)
        with urllib.request.urlopen(
            req, timeout=timeout or self.timeout
        ) as r:
            event = None
            while True:
                line = r.readline()
                if not line:
                    return
                line = line.decode().rstrip("\n")
                if line.startswith("event: "):
                    event = line[len("event: "):]
                elif line.startswith("data: ") and event is not None:
                    yield event, json.loads(line[len("data: "):])
                    event = None
