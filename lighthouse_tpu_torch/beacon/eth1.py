"""Eth1 deposit-log ingestion + genesis services.

Twin of beacon_node/eth1 (deposit_cache.rs, block_cache.rs, service.rs) and
beacon_node/genesis (eth1_genesis_service.rs, interop.rs): an incremental
deposit cache backed by the consensus DepositTree (proof source for
process_deposit), eth1-data vote selection over the follow-distance window,
and genesis triggering once min-genesis conditions are met.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..consensus.containers import Deposit, DepositData, Eth1Data
from ..consensus.merkle import DepositTree
from ..consensus.spec import ChainSpec


@dataclass
class Eth1Block:
    number: int
    hash: bytes
    timestamp: int
    deposit_count: int
    deposit_root: bytes


class DepositCache:
    """deposit_cache.rs: every deposit log in order, with proofs."""

    def __init__(self):
        self.tree = DepositTree()
        self.deposits: list[DepositData] = []

    def insert_log(self, index: int, data: DepositData) -> None:
        if index != len(self.deposits):
            raise ValueError(
                f"non-contiguous deposit log {index}, have {len(self.deposits)}"
            )
        self.deposits.append(data)
        self.tree.push(data.root())

    def deposit_root(self) -> bytes:
        return self.tree.root()

    def count(self) -> int:
        return len(self.deposits)

    def deposits_for_block(
        self, start_index: int, count: int, deposit_count: int | None = None
    ) -> list[Deposit]:
        """Build proof-carrying Deposits for inclusion (genesis or block
        production).  ``deposit_count`` pins proofs to the voted
        ``eth1_data`` snapshot — under saturation the log keeps growing
        past the vote, and a live-tip proof would fail verification
        against the snapshot's deposit_root."""
        stop = min(start_index + count, len(self.deposits))
        if deposit_count is not None:
            stop = min(stop, deposit_count)
        out = []
        for i in range(start_index, stop):
            out.append(
                Deposit(
                    proof=self.tree.proof(i, deposit_count),
                    data=self.deposits[i],
                )
            )
        return out


class Eth1Service:
    """service.rs condensed: block cache + deposit cache + the eth1-data
    vote choice (majority within the voting period, falling back to the
    follow-distance block)."""

    def __init__(self, spec: ChainSpec):
        self.spec = spec
        self.blocks: list[Eth1Block] = []
        self.deposit_cache = DepositCache()

    def insert_block(self, block: Eth1Block) -> None:
        self.blocks.append(block)

    def eth1_data_for_vote(self, state) -> Eth1Data:
        """Pick the eth1 vote: the latest block at follow distance, unless
        an existing vote within the period already leads."""
        votes = list(state.eth1_data_votes)
        if votes:
            counts: dict[bytes, int] = {}
            for v in votes:
                counts[v.root()] = counts.get(v.root(), 0) + 1
            best_root = max(counts, key=counts.get)
            for v in votes:
                if v.root() == best_root and counts[best_root] > len(votes) // 2:
                    return v
        if len(self.blocks) > self.spec.eth1_follow_distance:
            b = self.blocks[-(self.spec.eth1_follow_distance + 1)]
        elif self.blocks:
            b = self.blocks[0]
        else:
            return state.eth1_data
        return Eth1Data(
            deposit_root=b.deposit_root,
            deposit_count=b.deposit_count,
            block_hash=b.hash,
        )


def eth1_genesis_state(service: Eth1Service, spec: ChainSpec, fork: str = "base"):
    """eth1_genesis_service.rs: once min_genesis_active_validator_count
    valid deposits exist and min_genesis_time passed, build the genesis
    state by applying every deposit."""
    from ..consensus.containers import BeaconBlockHeader, Fork, types_for
    from ..consensus.state_processing.per_block import apply_deposit

    cache = service.deposit_cache
    if cache.count() < spec.min_genesis_active_validator_count:
        return None
    T = types_for(spec.preset)
    state = T.BeaconState_BY_FORK[fork](
        genesis_time=spec.min_genesis_time + spec.genesis_delay,
        fork=Fork(
            previous_version=spec.genesis_fork_version,
            current_version=spec.genesis_fork_version,
        ),
        latest_block_header=BeaconBlockHeader(),
        randao_mixes=[
            service.blocks[-1].hash if service.blocks else bytes(32)
        ] * spec.preset.epochs_per_historical_vector,
    )
    state.eth1_data = Eth1Data(
        deposit_root=cache.deposit_root(),
        deposit_count=cache.count(),
        block_hash=service.blocks[-1].hash if service.blocks else bytes(32),
    )
    for dd in cache.deposits:
        apply_deposit(state, dd, spec)
        state.eth1_deposit_index += 1
    # genesis activations: all deposited validators with max balance
    for v in state.validators:
        if v.effective_balance == spec.max_effective_balance:
            v.activation_eligibility_epoch = 0
            v.activation_epoch = 0
    gvr_field = type(state)._fields["validators"]
    state.genesis_validators_root = gvr_field.hash_tree_root(state.validators)
    if hasattr(state, "previous_epoch_participation"):
        n = len(state.validators)
        state.previous_epoch_participation = [0] * n
        state.current_epoch_participation = [0] * n
        state.inactivity_scores = [0] * n
    return state


# ---------------------------------------------------------------------------
# JSON-RPC ingestion (beacon_node/eth1/src/service.rs): the polling side
# that turns a live EL's eth_ namespace into the caches above.
# ---------------------------------------------------------------------------

# DepositEvent(bytes pubkey, bytes withdrawal_credentials, bytes amount,
# bytes signature, bytes index) — the deposit contract's only event.  The
# log data is the ABI encoding of five dynamic `bytes`; amount and index
# are 8-byte little-endian (deposit_contract.sol / eth1/src/lib.rs
# DepositLog::from_log does exactly this parse).
DEPOSIT_EVENT_TOPIC = bytes.fromhex(
    "649bbc62d0e31342afea4e5cd82d4049e7e1ee912fc0889aa790803be39038c5"
)


def _abi_pad(data: bytes) -> bytes:
    return data + b"\x00" * (-len(data) % 32)


def encode_deposit_log_data(data: "DepositData", index: int) -> bytes:
    """ABI-encode a DepositEvent's data section (the mock EL's side)."""
    parts = [
        bytes(data.pubkey),
        bytes(data.withdrawal_credentials),
        int(data.amount).to_bytes(8, "little"),
        bytes(data.signature),
        index.to_bytes(8, "little"),
    ]
    head, tail = b"", b""
    offset = 32 * len(parts)
    for p in parts:
        head += offset.to_bytes(32, "big")
        enc = len(p).to_bytes(32, "big") + _abi_pad(p)
        tail += enc
        offset += len(enc)
    return head + tail


def decode_deposit_log_data(raw: bytes) -> tuple["DepositData", int]:
    """Parse a DepositEvent data section -> (DepositData, deposit index)."""
    n_fields = 5
    parts = []
    for i in range(n_fields):
        offset = int.from_bytes(raw[32 * i : 32 * (i + 1)], "big")
        length = int.from_bytes(raw[offset : offset + 32], "big")
        parts.append(raw[offset + 32 : offset + 32 + length])
    pubkey, wc, amount, signature, index = parts
    if len(pubkey) != 48 or len(wc) != 32 or len(signature) != 96:
        raise ValueError("malformed deposit log field lengths")
    return (
        DepositData(
            pubkey=pubkey,
            withdrawal_credentials=wc,
            amount=int.from_bytes(amount, "little"),
            signature=signature,
        ),
        int.from_bytes(index, "little"),
    )


class Eth1JsonRpcClient:
    """Minimal eth_ namespace client (eth1/src/http.rs): blockNumber,
    getBlockByNumber, getLogs.  Public eth1 RPC endpoints (8545) carry no
    auth; pass ``jwt_secret`` when the eth_ calls ride the authenticated
    engine port (8551) instead."""

    def __init__(self, url: str, timeout: float = 5.0,
                 jwt_secret: bytes | None = None):
        self.url = url
        self.timeout = timeout
        self.jwt_secret = jwt_secret
        self._id = 0

    def call(self, method: str, params: list):
        from .execution import json_rpc_post, jwt_token

        self._id += 1
        headers = None
        if self.jwt_secret is not None:
            headers = {
                "Authorization": f"Bearer {jwt_token(self.jwt_secret)}"
            }
        return json_rpc_post(
            self.url, method, params, self._id, self.timeout, headers
        )

    def block_number(self) -> int:
        return int(self.call("eth_blockNumber", []), 16)

    def get_block(self, number: int) -> dict | None:
        return self.call("eth_getBlockByNumber", [hex(number), False])

    def get_logs(self, address: bytes, from_block: int, to_block: int) -> list:
        return self.call(
            "eth_getLogs",
            [
                {
                    "address": "0x" + address.hex(),
                    "fromBlock": hex(from_block),
                    "toBlock": hex(to_block),
                    "topics": ["0x" + DEPOSIT_EVENT_TOPIC.hex()],
                }
            ],
        )


class Eth1PollingService:
    """service.rs's update loop over the socket: fetch deposit logs in
    ranges, parse + insert into the DepositCache (contiguity enforced),
    then walk new blocks recording (deposit_count, deposit_root)
    snapshots into the Eth1Service block cache, and prune beyond the
    retention window.  Drives eth1-data votes and eth1-genesis from a
    live (or mock) EL instead of in-process feeding."""

    LOG_CHUNK = 1000  # blocks per eth_getLogs range (service.rs chunking)

    def __init__(self, service: Eth1Service, client: Eth1JsonRpcClient,
                 spec: ChainSpec | None = None):
        self.service = service
        self.client = client
        self.spec = spec or service.spec
        self.last_processed_block = -1
        self._thread = None
        self._stop = None

    def poll_once(self) -> int:
        """One update round; returns how many new blocks were processed.

        Cost shape on catch-up: logs are range-fetched (LOG_CHUNK blocks
        per eth_getLogs), and per-block header fetches happen ONLY inside
        the retention window — blocks that _prune would discard anyway
        are never fetched, so syncing N blocks costs N/LOG_CHUNK log
        calls + at most 2x-follow-distance header calls."""
        latest = self.client.block_number()
        if latest <= self.last_processed_block:
            return 0
        head_blk = self.client.get_block(latest)
        if head_blk is None:
            return 0  # empty chain: block_number's 0 is not a real block
        cache = self.service.deposit_cache
        processed = 0
        start = self.last_processed_block + 1
        keep_from = latest - 2 * self.spec.eth1_follow_distance
        for lo in range(start, latest + 1, self.LOG_CHUNK):
            hi = min(lo + self.LOG_CHUNK - 1, latest)
            logs_by_block: dict[int, list] = {}
            for entry in self.client.get_logs(
                self.spec.deposit_contract_address, lo, hi
            ):
                logs_by_block.setdefault(
                    int(entry["blockNumber"], 16), []
                ).append(entry)
            for n in range(lo, hi + 1):
                # logs first (ascending log index), then the block snapshot
                for entry in sorted(
                    logs_by_block.get(n, ()),
                    key=lambda e: int(e.get("logIndex", "0x0"), 16),
                ):
                    data, index = decode_deposit_log_data(
                        bytes.fromhex(entry["data"].removeprefix("0x"))
                    )
                    if index < cache.count():
                        continue  # re-fetched after a mid-poll failure
                    cache.insert_log(index, data)
                if n >= keep_from:
                    blk = (
                        head_blk
                        if n == latest
                        else self.client.get_block(n)
                    )
                    if blk is None:
                        raise IOError(f"eth1 block {n} disappeared mid-poll")
                    self.service.insert_block(
                        Eth1Block(
                            number=n,
                            hash=bytes.fromhex(blk["hash"].removeprefix("0x")),
                            timestamp=int(blk["timestamp"], 16),
                            deposit_count=cache.count(),
                            deposit_root=cache.deposit_root(),
                        )
                    )
                # cursor moves only once the block fully landed: a failed
                # header fetch re-runs this block next round (log inserts
                # above dedupe), keeping the block cache positionally
                # aligned with the real chain for the follow-distance vote
                self.last_processed_block = n
                processed += 1
        self._prune()
        return processed

    def _prune(self) -> None:
        """block_cache.rs retention: keep ~2x follow distance of blocks
        (votes reach back one follow distance; the margin absorbs skew)."""
        keep = 2 * self.spec.eth1_follow_distance + 1
        if len(self.service.blocks) > keep:
            del self.service.blocks[: len(self.service.blocks) - keep]

    def start(self, interval: float = 1.0) -> None:
        import threading

        self._stop = threading.Event()

        from ..utils.logging import get_logger

        log = get_logger("eth1")

        def loop():
            while not self._stop.is_set():
                try:
                    self.poll_once()
                except Exception as exc:  # noqa: BLE001 — EL flaps must
                    # not kill the service, but they must be VISIBLE
                    # (service.rs logs every failed update round)
                    log.warning("eth1 poll failed: %s", exc)
                self._stop.wait(interval)

        self._thread = threading.Thread(
            target=loop, daemon=True, name="eth1-poll"
        )
        self._thread.start()

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
